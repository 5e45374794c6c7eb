"""Training: AdamW, checkpoints, int8 gradient compression and the
fault-tolerant loop (the port of ``repro.train``)."""

from repro_torch.train import checkpoint, compression, optimizer

__all__ = ["checkpoint", "compression", "optimizer"]
