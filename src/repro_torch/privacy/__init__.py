"""Empirical privacy-audit subsystem (``repro/privacy``; Thm 3.3 /
Cor. D.2, Figs. 2 & 12).

``repro_torch.core.privacy`` holds the attack primitives (the MIA audit
with bootstrap CIs, DLG inversion, the MI bound algebra).  This package
turns them into an audit harness against what an adversary really
observes:

* ``views``   -- adversary-view geometry: the coordinate->aggregator
  assignment induced by the distributed step's per-leaf segment layout,
  reassembly of captured ``launch/train.py`` view payloads into the
  simulator's flat ``(A, K, n)`` form, and colluding-coalition unions.
* ``harness`` -- audit runs: capture views from the simulator
  (``FLConfig.keep_views``) or the distributed tap
  (``TrainSettings.capture_views``), sweep attacks over A and coalition
  size, and report leakage curves.
"""
from repro_torch.privacy import harness, views                 # noqa: F401
from repro_torch.privacy.views import (colluding_view,         # noqa: F401
                                       flat_views_from_leaves,
                                       mesh_flat_assignment, view_layouts)
