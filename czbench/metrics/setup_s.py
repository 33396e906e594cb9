"""setup_s: seconds from the run's first line to the end of the warm-up
solve (imports, kernel build or load, the Problem, the warm-up)."""


def read(facts):
    return facts["setup_s"]
