"""iters_per_solve: the program's stopping iterations (SolveResult.iters)
summed over the window's solves, over their number."""


def read(facts):
    s = facts["solves"]
    return sum(x.iters for x in s) / len(s)
