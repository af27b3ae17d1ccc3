"""The solver's ADMM iterations a problem, mean over every problem of the
traced window, from the step's own SolveStats.iterations (summed on the
device)."""


def read(ctx):
    problems = ctx.batch * ctx.steps
    return ctx.window.iterations / problems if problems else None
