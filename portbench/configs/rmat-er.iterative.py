"""Plain reference of ``rmat-er.iterative``: ITERATIVE (Alg. 2) in the
lockstep model of the configuration's ``concurrency`` threads, and its
control, the same with the conflicts left unrepaired after the first round
(it breaks the guarantee that no edge joins two vertices of one color)."""
from portbench import plain


def reference(g, config):
    return plain.iterative(g, int(config["spec"]["concurrency"]))


def control(g, config):
    return plain.iterative(g, int(config["spec"]["concurrency"]),
                           repair=False)
