"""Input pipeline of the port: its own numpy copies of the JAX package's
synthetic room blocks and batching (``toy``, ``batching``), the native host
library's binding (``native``) and the device transfer (``provider``)."""
