"""Share of the traced stretch's detect calls that replayed a captured CUDA
graph: the program's graph-cache counters (fdt_torch.infer.graphs), read at
the stretch's ends by the entry into the run's stats, replays over replays,
eager calls and captures together.  Nothing where the entry read no such
counters (an entry without the reading, a program without the cache)."""

KEYS = ("graph_replays", "graph_eager", "graph_captures")


def read(run):
    if not all(k in run.stats for k in KEYS):
        return None
    calls = sum(run.stats[k] for k in KEYS)
    return run.stats["graph_replays"] / calls if calls else None
