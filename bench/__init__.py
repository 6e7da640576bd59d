"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one cell run
once by ``python bench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``.  Everything a cell needs is found by name under this
folder: its configuration (``configs/``), its limits (``workloads/``),
its traffic mix and the generator that reads it (``traffic/``), the
graph generator (``graphs/``) and a reader per per-layer metric
(``metrics/``)."""
