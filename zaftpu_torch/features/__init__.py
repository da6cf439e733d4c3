"""Audio features: the mel filterbank, mel spectrogram and MFCCs."""
