"""Synthetic data (``repro/data``), drawn from the threefry stream."""
from repro_torch.data.synthetic import (  # noqa: F401
    balanced_dirichlet_indices, dirichlet_partition,
    federated_classification, federated_population, lm_token_batches,
    make_classification)
