"""The benchmark harness of the PyTorch and CUDA port (`mqe_tpu_torch`).

`run.py` is the command; this package holds what it runs: the cell's
configuration, traffic mix and metric readers found by name (`spec`), the
two traffic drivers (`drivers`), the yardstick (`yardstick`, `stats`,
`trace`), and the comparison with the plain reference that decides
`correct` (`check`, reference in `../reference/refsim`).
"""
