"""Set-up seconds: from the process's start to the first pass's clock
(imports, the graph from the seed, the program's builds where a checkout
has none yet, the warm-up, the first solver and its preparation)."""


def read(run: dict) -> float:
    return run["setup_s"]
