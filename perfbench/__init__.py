"""The benchmark of the ContFuse port (`dcf_torch`): `run.py` is its
command, `BENCHMARK.json` at the repository's root its cells."""
