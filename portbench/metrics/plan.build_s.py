"""Host seconds of planning in set-up: the topology's decoding,
``compile_graph`` and ``Simulator(...)``, timed around the calls."""


def read(ctx):
    return ctx.plan_build_s
