"""The benchmark of the PyTorch and CUDA port, ``gdm_torch``.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of BENCHMARK.json once and prints one JSON
line.  Everything that belongs to one configuration, traffic mix,
per-layer metric or cell is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``
and ``limits/<cell>.json``; a configuration names its family, the
module ``families/<family>.py`` that builds the port's problem and the
plain reference's (``reference/``).
"""
