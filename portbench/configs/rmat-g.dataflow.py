"""Plain reference of ``rmat-g.dataflow``: serial first-fit in vertex-id
order, which DATAFLOW's fixpoint equals; and its control, first-fit in the
reverse order (a valid coloring that breaks the guarantee of the
id-order greedy)."""
from portbench import plain


def reference(g, config):
    return plain.greedy(g)


def control(g, config):
    return plain.greedy(g, reverse=True)
