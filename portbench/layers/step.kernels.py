"""``step.kernels``: the kernel nodes of the captured rollout graph,
counted by name in its DOT dump, a step (the graph runs
``steps_per_call`` steps and the copies that hand its state and outputs
back).  A replay launches each node once."""


def read(run):
    if not run.graph_nodes or not run.graph_steps:
        return None
    return len(run.graph_nodes) / run.graph_steps
