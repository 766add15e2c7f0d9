"""The benchmark of findnpropagate_torch on one H100: `run.py` runs one
cell of BENCHMARK.json; see README.md."""
