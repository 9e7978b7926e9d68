"""gbbench: the benchmark of graphblas_tpu_torch on an NVIDIA GPU.

``python3 gbbench/run.py --workload <config>.<traffic> --seed <n>
--seconds <s> --trace <0|1>`` generates a graph from the seed, loads it
into the port with ``Matrix.from_coo``, runs the traffic's algorithm in a
closed loop for the given seconds, checks the results against a plain
reference and prints one JSON line.  Every piece is found by its name in
``BENCHMARK.json``: ``configs/<config>.json`` (the graph),
``traffic/<traffic>.json`` (the calls, read by ``drivers/<driver>.py``)
and ``metrics/<metric>.py`` (one reader per metric).
"""
