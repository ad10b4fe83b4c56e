"""ERIS core (``repro/core``): Federated Shard Aggregation and Distributed
Shifted Compression, the synchronous round pipeline and its simulator."""
