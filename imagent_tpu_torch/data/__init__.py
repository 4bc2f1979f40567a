"""Data: deterministic sample streams, the uint8 wire, loaders and
device staging."""

from imagent_tpu_torch.data.pipeline import make_loaders
