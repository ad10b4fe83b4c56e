"""The DSC cases of ``tests/test_torch_fl_flash.py``'s whole ERIS rounds
with flash attention on both sides (split from ``tests/test_torch_fl.py``):
DSC through the Pallas path, fused on the int8 wire, the jnp path, and
the jnp path on the int8 wire.
"""
import pytest

pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from test_torch_fl_flash import FLASH_ROUNDS, check_flash_round  # noqa: E402


@pytest.mark.parametrize("case", sorted(c for c in FLASH_ROUNDS
                                        if c.startswith("dsc")))
def test_flrun_with_flash_tracks_reference_on_the_smoke_model(case):
    check_flash_round(case)
