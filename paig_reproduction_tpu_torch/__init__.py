"""PyTorch/CUDA port of paig_reproduction_tpu (Physics-as-Inverse-Graphics).

The JAX package ``paig_reproduction_tpu`` is the reference; this package
imports none of it. Layouts at the public functions follow the JAX package.
"""
