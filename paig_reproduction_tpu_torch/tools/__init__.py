"""The offline training-pipeline tools on the port's checkpoints.

Counterparts of the JAX package's ``tools/fit_physics.py``,
``tools/slot_rescue.py``, ``tools/analyze_tail.py`` and
``tools/seed_sweep.py``, with their flags, defaults and printed lines; each
runs as ``python -m paig_reproduction_tpu_torch.tools.<name>`` and reads
and writes the port's ``model.ckpt`` (``train/checkpoint.py``). Those that
run a model take the port CLI's ``--device`` (default ``cuda``).
"""
