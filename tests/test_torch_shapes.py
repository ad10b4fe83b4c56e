"""The port's assigned input shapes against the reference's
(``repro/launch/shapes.py``): ``SHAPES`` field for field, the decode
window policy, and every input spec of every zoo arch at every shape,
shape and dtype, against the reference's ``ShapeDtypeStruct``s (its
decode cache from ``jax.eval_shape``); the port's are meta tensors."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro import configs as ref_configs  # noqa: E402
from repro.launch import shapes as ref_shapes  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import shapes  # noqa: E402


def test_shapes_equal_reference():
    assert shapes.LONG_WINDOW == ref_shapes.LONG_WINDOW
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_shapes.SHAPES.items()}


def _flat(tree, path=()):
    """{key path: (shape, dtype name)} of a nested dict of arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    dtype = str(tree.dtype).replace("torch.", "")
    return {path: (tuple(tree.shape), np.dtype(dtype).name)}


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_input_specs_equal_reference(arch):
    """Every shape's specs: the same keys, shapes and dtypes (the float16
    frontend embeds and cache included), all on the meta device."""
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    for name, shape in shapes.SHAPES.items():
        assert shapes.decode_window(cfg, shape) == \
            ref_shapes.decode_window(ref_cfg, ref_shapes.SHAPES[name])
        got = shapes.input_specs(cfg, name)
        want = ref_shapes.input_specs(ref_cfg, name)
        assert _flat(got) == _flat(jax.tree.map(lambda x: x, want)), name
        assert all(t.device.type == "meta"
                   for t in torch.utils._pytree.tree_leaves(got))
