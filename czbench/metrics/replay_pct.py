"""replay_pct: the device time of the stop's replay (the CUDA event pair
around ``run_iterative``'s replay of the stopping chunk, the program's
``replay_s``), summed over the traced solves, over their summed wall
times, in %.  Nothing where the program keeps no such record or keeps it
off the card."""

from czb.spans import traced


def read(facts):
    recs = traced(facts)
    if recs is None or any(getattr(r, "replay_s", None) is None for r in recs):
        return None
    wall = sum(s.seconds for s in facts["traced"])
    return 100.0 * sum(r.replay_s for r in recs) / wall
