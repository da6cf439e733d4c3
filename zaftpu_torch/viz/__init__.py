"""The display helpers (the port of ``zaftpu.viz``)."""

from zaftpu_torch.viz.display import (  # noqa: F401
    amplitude_to_db,
    cqtchromshow,
    cqtspecshow,
    melspecshow,
    mfccshow,
    sigplot,
    specshow,
)
