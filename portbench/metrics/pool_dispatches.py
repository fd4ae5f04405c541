"""Mean per job of the pool's device batch calls
(``DeviceBatchPool.n_dispatches``)."""


def read(run):
    counts = [r["counters"]["pool_dispatches"] for r in run.records
              if "pool_dispatches" in r["counters"]]
    return sum(counts) / len(counts) if counts else None
