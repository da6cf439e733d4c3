"""WAV I/O, the native block codec and the resumable streaming pipeline."""
