"""The benchmark of the PyTorch and CUDA port, ``jylis_tpu_torch``: one
node on the card, driven over its real RESP and cluster wire by worker
processes, and checked against plain references. ``python -m cardbench
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` runs one
cell of BENCHMARK.json (run.py)."""
