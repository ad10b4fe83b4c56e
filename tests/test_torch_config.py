"""The port's data and plumbing against the reference: the config registry
field for field, the kernel RNG bit for bit, the parameter layout and its
converter, and the rule that ``src/repro_torch`` and ``chip_smoke.py``
import neither jax nor the reference package."""
import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro import configs as ref_configs  # noqa: E402
from repro.kernels import common as ref_common  # noqa: E402
from repro.models import transformer as ref_tr  # noqa: E402
from repro_torch import configs, resolve_device  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_config_equals_reference_field_by_field(arch):
    ref = ref_configs.get_config(arch)
    got = configs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert dataclasses.asdict(got.smoke()) == dataclasses.asdict(ref.smoke())
    assert (got.hd, got.q_dim, got.kv_dim, got.param_count()) == \
        (ref.hd, ref.q_dim, ref.kv_dim, ref.param_count())
    assert configs.canonical(ref.name) == ref_configs.canonical(ref.name)


def test_registry_surface_equals_reference():
    assert configs.ARCHS == ref_configs.ARCHS
    for alias in ("qwen2-0.5b", "eris_gptneo_1_3b", "Phi3.5-MoE-42B-A6.6B",
                  "xlstm-350m"):
        assert configs.canonical(alias) == ref_configs.canonical(alias)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_hash_and_uniform_bit_exact():
    idx = np.concatenate([np.arange(4096), [2**31 - 1, 2**31, 2**32 - 1]])
    for seed in (0, 1, 0xDEADBEEF, 2**32 - 1):
        ref_u = ref_common.uniform_from_index(
            jnp.asarray(idx, jnp.uint32), jnp.uint32(seed))
        got_u = common.uniform_from_index(torch.from_numpy(idx), seed)
        np.testing.assert_array_equal(got_u.numpy(), np.asarray(ref_u))
        ref_h = ref_common.hash_u32(jnp.asarray(idx, jnp.uint32) ^
                                    jnp.uint32(seed))
        got_h = common.hash_u32(torch.from_numpy(idx) ^ seed)
        np.testing.assert_array_equal(got_h.numpy(),
                                      np.asarray(ref_h).astype(np.int64))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "eris-gptneo-1.3b",
                                  "musicgen-medium", "qwen3-32b",
                                  "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"])
def test_param_spec_and_init_match_reference_layout(arch):
    cfg = configs.get_config(arch).smoke()
    ref_spec = ref_tr.param_spec(ref_configs.get_config(arch).smoke())
    assert tr.param_spec(cfg) == ref_spec
    params = tr.init_params(cfg, seed=3, device="cpu")
    shapes = {k: (tuple(v.shape) if not isinstance(v, dict) else
                  {n: tuple(t.shape) for n, t in v.items()})
              for k, v in params.items()}
    assert shapes == ref_spec
    # fan-in scaling as the reference: std ~ fan_in ** -0.5
    wq = params["blocks"]["wq"]
    assert abs(float(wq.float().std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert torch.equal(params["blocks"]["ln1"],
                       torch.ones_like(params["blocks"]["ln1"]))
    again = tr.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(again["embed"], params["embed"])


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_every_zoo_param_spec_and_paged_families_equal_the_reference(arch):
    """Every zoo config's ``param_spec`` at full width and at its smoke
    size equals the reference's, leaf order included (a leaf's place is
    its ``fold_in`` index), and the paged families are the reference's
    tuple."""
    for cfg, ref in ((configs.get_config(arch), ref_configs.get_config(arch)),
                     (configs.get_config(arch).smoke(),
                      ref_configs.get_config(arch).smoke())):
        spec, want = tr.param_spec(cfg), ref_tr.param_spec(ref)
        assert spec == want
        assert list(spec) == list(want)
        assert list(spec["blocks"]) == list(want["blocks"])
    assert tr.paged_families() == ref_tr.paged_families()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_is_bit_exact(dtype):
    cfg = dataclasses.replace(ref_configs.get_config("qwen2-0.5b").smoke(),
                              dtype=dtype)
    ref = ref_tr.init_params(jax.random.PRNGKey(1), cfg)
    got = params_from_jax(jax.tree.map(np.asarray, ref), "cpu")
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    assert len(flat_ref) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat_ref:
        t = got
        for k in path:
            t = t[k.key]
        assert t.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    cfg = configs.get_config("qwen2-0.5b").smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.init_params(cfg)
    assert resolve_device("cpu") == torch.device("cpu")
