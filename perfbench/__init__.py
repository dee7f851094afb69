"""The benchmark of the PyTorch/CUDA port (``triple_hybrid_rag_tpu_torch``) on one
H100: ``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
