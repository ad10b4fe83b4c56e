"""Synthetic data (``repro/data``), drawn from the threefry stream."""
from repro_torch.data.synthetic import (federated_classification,  # noqa: F401
                                        lm_token_batches,
                                        make_classification)
