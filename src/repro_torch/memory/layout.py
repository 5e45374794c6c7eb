"""Far-memory record layout (paper Fig. 3 / §III-D).

Fast memory  : PQ codes (N, M) uint8 + PQ codebooks + IVF/graph index.
Far memory   : per record, per TRQ level — packed ternary code
               (⌈D/5⌉ B) + 8 B scalars (⟨x_c,δ⟩ f32, ‖δ‖² f32).
Storage(SSD) : full-precision vectors (D×4 B), touched only by survivors.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.packing import packed_size


@dataclass(frozen=True)
class RecordLayout:
    dim: int
    pq_m: int
    levels: int = 1
    store_rho: bool = False   # +4 B/level enables the provable Cauchy bound

    @property
    def fast_bytes(self) -> int:
        """Per-record fast-memory payload (PQ code)."""
        return self.pq_m

    @property
    def far_bytes(self) -> int:
        scalars = 12 if self.store_rho else 8
        return self.levels * packed_size(self.dim) + scalars

    @property
    def ssd_bytes(self) -> int:
        return self.dim * 4

    def describe(self) -> dict[str, int]:
        return {"fast_B": self.fast_bytes, "far_B": self.far_bytes,
                "ssd_B": self.ssd_bytes}
