"""Process start to the first timed job (s): imports, the card, the
kernels' build (first run of a checkout only), inputs, prepare, warm-up."""


def read(ctx):
    return ctx["setup_s"]
