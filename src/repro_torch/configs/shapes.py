"""Assigned input-shape sets (identical across the 10 LM-family archs).
Counterpart of ``repro.configs.shapes`` (a copy: the port imports nothing of
the JAX package).

  train_4k     seq_len=4096    global_batch=256   → train_step
  prefill_32k  seq_len=32768   global_batch=32    → prefill_step
  decode_32k   seq_len=32768   global_batch=128   → decode_step (KV cache)
  long_500k    seq_len=524288  global_batch=1     → decode_step; only for
               sub-quadratic archs (SSM / hybrid / SWA) — see DESIGN.md §4.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Archs allowed to run long_500k (sub-quadratic attention / SSM / SWA ring
# cache).  Pure full-attention archs skip it.
LONG_OK = {
    "mamba2-1.3b", "zamba2-1.2b", "h2o-danube-1.8b", "h2o-danube-3-4b",
}


def cells_for(arch_id: str) -> list[str]:
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch_id in LONG_OK:
        cells.append("long_500k")
    return cells
