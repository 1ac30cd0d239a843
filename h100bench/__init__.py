"""The benchmark of the PyTorch / CUDA port on one H100 (see BENCHMARK.json)."""
