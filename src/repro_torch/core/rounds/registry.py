"""Method registry (``repro/core/rounds/registry.py``): every ported
``FLConfig.method`` as a declarative stage composition.

  method   compress                   aggregate                server
  ------   ------------------------   ----------------------   -------
  fedavg   (identity)                 weighted mean            -lr*u
  eris     [DSC | EF | -] [+int8]     FSA (DSC-compensated)    fedavg |
                                                               fedadam |
                                                               fedyogi

The other methods of the reference (min_leakage, fedavg_ldp, soteriafl,
priprune, shatter, secure_agg, and the async fedbuff / eris_async), and
the eris branches for LDP noise, secure masking and failure injection,
come with ROADMAP queue 1.7.  They raise naming it.

Builders take (cfg, n) duck-typed and return a frozen RoundPipeline.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core import dsc as dsc_lib
from repro_torch.core.compressors import Int8RoundTrip
from repro_torch.core.pipeline import (AggregateStage, ClientStep,
                                       DSCAggregate, DSCCompress, EFCompress,
                                       FSASharded, Int8Wire, RoundPipeline,
                                       ServerStage)

_LATER = ("min_leakage", "fedavg_ldp", "soteriafl", "priprune", "shatter",
          "secure_agg", "fedbuff", "eris_async")


def _not_ported(what: str, queue: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue "
                               f"{queue})")


def _gamma(cfg, n: int) -> float:
    if cfg.gamma is not None:
        return cfg.gamma
    if getattr(cfg, "use_dsc", False):
        return dsc_lib.gamma_star(cfg.compressor.omega(n))
    return 0.0


def _build_fedavg(cfg, n):
    return RoundPipeline(aggregate=AggregateStage(),
                         server=ServerStage(opt="fedavg", lr=cfg.lr),
                         view="transmitted")


def _build_eris(cfg, n):
    gamma = _gamma(cfg, n)
    int8 = getattr(cfg, "int8_wire", False)
    compressor = cfg.compressor
    impl = getattr(cfg, "compress_impl", "jnp")
    if getattr(cfg, "ldp", None) is not None:
        raise _not_ported("eris with LDP noise (FLConfig.ldp)", "1.7")
    if getattr(cfg, "secure_mask", False):
        raise _not_ported("eris with secure_mask", "1.7")
    if cfg.agg_dropout > 0 or cfg.link_failure > 0:
        raise _not_ported("eris with failure injection (agg_dropout, "
                          "link_failure)", "1.7")
    if int8 and (cfg.use_dsc or cfg.use_ef):
        # the wire format INSIDE the shifted / error-feedback compressor,
        # so the client references update with exactly what the
        # aggregators receive; only the fused kernel keeps the composition
        # in one pass, any other impl routes through the dense compressor
        compressor = Int8RoundTrip(inner=compressor)
        impl = "fused" if impl == "fused" else "jnp"
    compress: tuple = ()
    if cfg.use_dsc:
        compress += (DSCCompress(compressor=compressor, gamma=gamma,
                                 impl=impl),)
    elif cfg.use_ef:
        compress += (EFCompress(compressor=compressor),)
    elif int8:
        compress += (Int8Wire(),)
    keep_views = getattr(cfg, "keep_views", False)
    if getattr(cfg, "fresh_masks", False) or keep_views:
        aggregate = FSASharded(
            A=cfg.A, mask_scheme=cfg.mask_scheme,
            fresh_masks=getattr(cfg, "fresh_masks", False),
            use_dsc=cfg.use_dsc, gamma=gamma, keep_views=keep_views)
    elif cfg.use_dsc:
        aggregate = DSCAggregate(gamma=gamma)
    else:
        aggregate = AggregateStage()
    return RoundPipeline(client=ClientStep(), compress=compress,
                         aggregate=aggregate,
                         server=ServerStage(opt=cfg.server_opt, lr=cfg.lr),
                         view="transmitted")


METHODS: dict[str, Callable] = {
    "fedavg": _build_fedavg,
    "eris": _build_eris,
}


def build_round(cfg, n: int) -> RoundPipeline:
    """FLConfig -> declarative round pipeline for its method."""
    if cfg.method in _LATER:
        raise _not_ported(f"method {cfg.method!r}", "1.7")
    try:
        builder = METHODS[cfg.method]
    except KeyError:
        raise ValueError(f"unknown method {cfg.method!r} "
                         f"(have {sorted(METHODS)})") from None
    return builder(cfg, n)
