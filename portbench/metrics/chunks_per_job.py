"""``chunks_per_job``: the chunks a job's stream or sort flow maps and
folds, one launch group each: the program's ``chunks`` counter over its
``runs`` (``repro_torch.spans``; process totals, whose runs all fold the
cell's items).  Nothing from a program without those counters."""

from portbench import program


def read(r):
    return program.counter_ratio("chunks", "runs")
