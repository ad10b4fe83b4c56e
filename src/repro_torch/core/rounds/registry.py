"""Method registry (``repro/core/rounds/registry.py``): every
``FLConfig.method`` as a declarative stage composition.  Reading this
file is the paper's Table-1 comparison:

  method       compress                 aggregate               server
  ----------   ----------------------   ---------------------   -------
  fedavg       (identity)               weighted mean            -lr*u
  min_leakage  (identity)               weighted mean            -lr*u
  fedavg_ldp   LDP noise                mean                     -lr*u
  soteriafl    [LDP noise +] DSC        DSC shift-compensated    -lr*u
  priprune     top-|g| withholding      mean                     -lr*u
  shatter      (identity)               chunked r-subset         -lr*u
  secure_agg   (identity)               pairwise-masked mean     -lr*u
  eris         [LDP] [DSC | EF | -]     FSA (DSC-compensated /   fedavg |
               [+int8] [+pair masks]    failure-injected)        fedadam |
                                                                 fedyogi
  fedbuff      [int8]                   buffered async mean      -lr*u
  eris_async   (as eris)                buffered async FSA       (as eris)

``fedbuff`` / ``eris_async`` wrap the synchronous aggregate in
:class:`BufferedAggregate` and, when ``FLConfig.population`` is set,
draw a keyed K-client cohort from the population each round.

Builders take (cfg, n) duck-typed and return a frozen RoundPipeline.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core import baselines as bl
from repro_torch.core import dsc as dsc_lib
from repro_torch.core.compressors import Int8RoundTrip
from repro_torch.core.pipeline import (AggregateStage, BufferedAggregate,
                                       ClientStep, DSCAggregate, DSCCompress,
                                       EFCompress, FailureInjectedFSA,
                                       FSASharded, Int8Wire, LDPNoise,
                                       PairwiseMask, PruneWithhold,
                                       RoundPipeline, SecureAggAggregate,
                                       ServerStage, ShatterAggregate)


def _gamma(cfg, n: int) -> float:
    if cfg.gamma is not None:
        return cfg.gamma
    if getattr(cfg, "use_dsc", False):
        return dsc_lib.gamma_star(cfg.compressor.omega(n))
    return 0.0


def _fedavg_server(cfg) -> ServerStage:
    return ServerStage(opt="fedavg", lr=cfg.lr)


def _build_fedavg(cfg, n):
    return RoundPipeline(aggregate=AggregateStage(use_weights=True),
                         server=_fedavg_server(cfg), view="transmitted")


def _build_min_leakage(cfg, n):
    # FedAvg iterates; the adversary sees only the final model.
    return RoundPipeline(aggregate=AggregateStage(use_weights=True),
                         server=_fedavg_server(cfg), view="none")


def _build_fedavg_ldp(cfg, n):
    return RoundPipeline(
        compress=(LDPNoise(ldp=cfg.ldp or bl.LDPConfig(), key_role="noise"),),
        aggregate=AggregateStage(use_weights=False),
        server=_fedavg_server(cfg), view="transmitted")


def _build_soteriafl(cfg, n):
    gamma = cfg.gamma if cfg.gamma is not None else \
        dsc_lib.gamma_star(cfg.compressor.omega(n))
    stages: tuple = ()
    if cfg.ldp is not None:
        stages += (LDPNoise(ldp=cfg.ldp, key_role="comp0"),)
    stages += (DSCCompress(compressor=cfg.compressor, gamma=gamma,
                           key_role="comp1"),)
    return RoundPipeline(
        compress=stages,
        aggregate=DSCAggregate(gamma=gamma, use_weights=False),
        server=_fedavg_server(cfg), view="none")


def _build_priprune(cfg, n):
    return RoundPipeline(compress=(PruneWithhold(rate=cfg.prune_rate),),
                         aggregate=AggregateStage(use_weights=False),
                         server=_fedavg_server(cfg), view="none")


def _build_shatter(cfg, n):
    return RoundPipeline(
        aggregate=ShatterAggregate(chunks=cfg.shatter_chunks,
                                   r=cfg.shatter_r, key_role="comp"),
        server=_fedavg_server(cfg), view="none")


def _build_secure_agg(cfg, n):
    return RoundPipeline(aggregate=SecureAggAggregate(key_role="comp"),
                         server=_fedavg_server(cfg), view="none")


def _build_eris(cfg, n):
    gamma = _gamma(cfg, n)
    int8 = getattr(cfg, "int8_wire", False)
    compressor = cfg.compressor
    impl = getattr(cfg, "compress_impl", "jnp")
    if int8 and (cfg.use_dsc or cfg.use_ef):
        # the wire format INSIDE the shifted / error-feedback compressor,
        # so the client references update with exactly what the
        # aggregators receive; only the fused kernel keeps the composition
        # in one pass, any other impl routes through the dense compressor
        compressor = Int8RoundTrip(inner=compressor)
        impl = "fused" if impl == "fused" else "jnp"
    compress: tuple = ()
    if getattr(cfg, "ldp", None) is not None:
        # composed-defense scenarios: clip + Gaussian noise BEFORE any
        # compression/masking (SoteriaFL's noise-then-compress order)
        compress += (LDPNoise(ldp=cfg.ldp, key_role="noise"),)
    if cfg.use_dsc:
        compress += (DSCCompress(compressor=compressor, gamma=gamma,
                                 key_role="comp", impl=impl),)
    elif cfg.use_ef:
        compress += (EFCompress(compressor=compressor, key_role="comp"),)
    elif int8:
        compress += (Int8Wire(key_role="wire"),)
    secure_mask = getattr(cfg, "secure_mask", False)
    failures = cfg.agg_dropout > 0 or cfg.link_failure > 0
    if secure_mask:
        if (failures or cfg.participation < 1.0
                or getattr(cfg, "client_dropout", 0.0) > 0.0):
            raise ValueError(
                "secure_mask cannot compose with failures/dropout/partial "
                "participation: pairwise masks cancel only in the "
                "unweighted full-cohort mean, and this simplified "
                "Bonawitz protocol has no dropout-recovery round — the "
                "aggregate would be garbage of magnitude `scale`")
        compress += (PairwiseMask(key_role="noise"),)
    keep_views = getattr(cfg, "keep_views", False)
    if failures:
        aggregate = FailureInjectedFSA(
            A=cfg.A, mask_scheme=cfg.mask_scheme,
            agg_dropout=cfg.agg_dropout, link_failure=cfg.link_failure,
            use_dsc=cfg.use_dsc, gamma=gamma, key_role="fail",
            keep_views=keep_views)
    elif getattr(cfg, "fresh_masks", False) or keep_views:
        # the paper's m^t path and/or the privacy-audit path: literal FSA
        aggregate = FSASharded(
            A=cfg.A, mask_scheme=cfg.mask_scheme,
            fresh_masks=getattr(cfg, "fresh_masks", False),
            use_dsc=cfg.use_dsc, gamma=gamma, keep_views=keep_views,
            key_role="mask")
    elif cfg.use_dsc:
        aggregate = DSCAggregate(gamma=gamma, use_weights=True)
    else:
        aggregate = AggregateStage(use_weights=True)
    return RoundPipeline(client=ClientStep(), compress=compress,
                         aggregate=aggregate,
                         server=ServerStage(opt=cfg.server_opt, lr=cfg.lr),
                         view="transmitted")


# ------------------------------------------------ async (population-scale)
def _as_async(pipeline: RoundPipeline, cfg) -> RoundPipeline:
    """Wrap a synchronous pipeline's aggregate in the FedBuff-style
    buffered stage and (when ``population`` is set) a keyed per-round
    cohort draw.  With the trivial arrival model and ``cadence=1`` the
    wrapped pipeline is the synchronous one bit for bit.  The knobs
    resolve through :class:`repro_torch.core.settings.AsyncSettings`;
    duck-typed cfgs without ``async_settings()`` read the flat fields."""
    from repro_torch.core.settings import AsyncSettings
    if getattr(cfg, "use_dsc", False) or getattr(cfg, "use_ef", False):
        raise ValueError(
            "buffered async aggregation does not compose with per-client "
            "shift/error-feedback state: DSC's s_agg (Eq. 4) tracks what "
            "aggregators receive EVERY round, which a cadence-delayed "
            "buffered apply breaks (run use_dsc/use_ef synchronously, or "
            "int8_wire for a stateless wire format)")
    if hasattr(cfg, "async_settings"):
        a = cfg.async_settings()
    else:
        a = AsyncSettings.from_knobs(cfg)
    aggregate = BufferedAggregate(inner=pipeline.aggregate,
                                  arrival=a.arrival_model(),
                                  cadence=a.buffer_cadence,
                                  key_role="fail")
    return dataclasses.replace(pipeline, aggregate=aggregate,
                               cohort=a.cohort(cfg.K))


def _build_fedbuff(cfg, n):
    """FedAvg client/server around the buffered async aggregate (+ the
    int8 wire stage when configured): the FedBuff baseline."""
    compress: tuple = ()
    if getattr(cfg, "int8_wire", False):
        compress += (Int8Wire(key_role="wire"),)
    base = RoundPipeline(compress=compress,
                         aggregate=AggregateStage(use_weights=True),
                         server=_fedavg_server(cfg), view="transmitted")
    return _as_async(base, cfg)


def _build_eris_async(cfg, n):
    """ERIS's FSA aggregation buffered FedBuff-style with cohort
    sampling: the population-scale serverless composition."""
    return _as_async(_build_eris(cfg, n), cfg)


METHODS: dict[str, Callable] = {
    "fedavg": _build_fedavg,
    "min_leakage": _build_min_leakage,
    "fedavg_ldp": _build_fedavg_ldp,
    "soteriafl": _build_soteriafl,
    "priprune": _build_priprune,
    "shatter": _build_shatter,
    "secure_agg": _build_secure_agg,
    "eris": _build_eris,
    "fedbuff": _build_fedbuff,
    "eris_async": _build_eris_async,
}


def build_round(cfg, n: int) -> RoundPipeline:
    """FLConfig -> declarative round pipeline for its method."""
    try:
        builder = METHODS[cfg.method]
    except KeyError:
        raise ValueError(f"unknown method {cfg.method!r} "
                         f"(have {sorted(METHODS)})") from None
    return builder(cfg, n)
