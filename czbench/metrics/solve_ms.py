"""solve_ms: the time to a converged solve, the whole window over the
solves it completed, in ms (inputs made on the card included)."""


def read(facts):
    return 1e3 * facts["window_s"] / len(facts["solves"])
