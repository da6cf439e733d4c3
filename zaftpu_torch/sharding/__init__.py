"""Frame-block sharding on ``torch.distributed``: the port of
``zaftpu.sharding`` (see :mod:`zaftpu_torch.sharding.sharded` for the SPMD
contract). :func:`gather` puts the blocks the sharded functions return
back together."""

from zaftpu_torch.sharding.mesh import (  # noqa: F401
    BATCH_AXIS,
    FRAME_AXIS,
    gather,
    initialize_distributed,
    make_mesh,
    make_mesh_2d,
    shard_along,
)
from zaftpu_torch.sharding.sharded import (  # noqa: F401
    cqtchromagram_sharded,
    cqtspectrogram_sharded,
    cqtspectrogram_tp,
    imdct_sharded,
    istft_sharded,
    mdct_sharded,
    melspectrogram_sharded,
    mfcc_sharded,
    spectrogram_sharded,
    stft_sharded,
)
