"""The assigned input shapes and their input specs, with no allocation
(``repro/launch/shapes.py``).

  train_1k       seq_len=  1,024  global_batch= 256  (training; CI-sized
                                                      dry runs)
  train_4k       seq_len=  4,096  global_batch= 256  (training)
  prefill_32k    seq_len= 32,768  global_batch=  32  (inference-prefill)
  decode_32k     seq_len= 32,768  global_batch= 128  (inference-decode)
  long_500k      seq_len=524,288  global_batch=   1  (long-context-decode)

Decode shapes feed the serving step (ONE new token + a KV cache of
seq_len).  ``long_500k`` takes the sub-quadratic path: recurrent state for
ssm and hybrid, a sliding-window (8192) ring cache for the full-attention
archs.

The specs are meta tensors (``device="meta"``): shape and dtype, no
storage, where the reference has ``ShapeDtypeStruct``s.  Their dtypes are
the reference's, the float16 frontend embeds and cache included.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig

LONG_WINDOW = 8192


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_1k": InputShape("train_1k", 1024, 256, "train"),
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def decode_window(cfg: ModelConfig, shape: InputShape) -> Optional[int]:
    """Sliding-window policy: long_500k uses a ring cache for attention
    archs; ssm archs have no KV cache at all."""
    if shape.name == "long_500k" and cfg.family != "ssm":
        return LONG_WINDOW
    return None


def token_spec(cfg: ModelConfig, batch: int, seq: int) -> dict:
    n_pre = cfg.n_frontend_tokens if cfg.frontend == "vlm" else 0
    spec = {"tokens": torch.empty((batch, seq - n_pre), dtype=torch.int32,
                                  device="meta")}
    if cfg.frontend == "vlm":
        spec["frontend_embeds"] = torch.empty(
            (batch, cfg.n_frontend_tokens, cfg.d_frontend),
            dtype=torch.float16, device="meta")
    return spec


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta stand-ins for every model input of the step that this (arch,
    shape) pair runs."""
    shape = SHAPES[shape_name]
    if shape.kind in ("train", "prefill"):
        return token_spec(cfg, shape.global_batch, shape.seq_len)
    # decode: one token + cache
    cache = tr.init_cache(cfg, shape.global_batch, shape.seq_len,
                          window=decode_window(cfg, shape),
                          dtype=torch.float16, device="meta")
    return {"token": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                 device="meta"),
            "pos": torch.empty((), dtype=torch.int32, device="meta"),
            "cache": cache}
