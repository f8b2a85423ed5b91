"""GiB held by the parameters and the optimizer state: the bytes of every
device tensor of the two trees, each storage counted once."""


def read(ctx):
    return ctx.state_bytes / 2 ** 30 if ctx.state_bytes else None
