"""Checkpoints (``repro/checkpoint``) in the reference's msgpack format."""
from repro_torch.checkpoint.msgpack_ckpt import (restore,  # noqa: F401
                                                 restore_any,
                                                 restore_sharded, save,
                                                 save_sharded)
