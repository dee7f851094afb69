"""``prep_ms.batch``: host ms a batch in the engine's host prep
(``Engine.prepare_queries``: planner, analyzer, query vectors and tokens, entity
seeds), the mean of the benchmark's ``bench.prep`` span, which synchronizes the
device at its ends in the traced run."""


def read(t):
    s = t.spans.get("bench.prep")
    return 1e3 * sum(s) / len(s) if s else None
