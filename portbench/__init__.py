"""portbench: the end-to-end benchmark of the PyTorch/CUDA port
(``spsparse_torch``) on one NVIDIA H100.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix):

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, mix or metric sits in a file
of its own, found by the name that ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``mixes/<traffic>.json`` (which names its job
module ``jobs/<job>.py``), ``metrics/<metric>.py``. The input generators
(``gen/``) and the plain references (``reference/``) import nothing of the
port. Nothing here imports JAX or the JAX package.
"""
