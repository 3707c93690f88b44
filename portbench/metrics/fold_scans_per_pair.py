"""``fold_scans_per_pair``: the times the keyed folds read each pair they
fold: the program's ``fold_scans`` counter over its ``fold_pairs``
(``repro_torch.spans``; a fold kernel's blocks each stream their
segment's pairs, so a fold of n pairs scans n × key tiles × column tiles;
process totals, whose folds all take the cell's plan).  Nothing from a
program without those counters."""

from portbench import program


def read(r):
    return program.counter_ratio("fold_scans", "fold_pairs")
