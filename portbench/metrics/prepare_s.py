"""Host clock from the generated entries on the device to the prepared
operator or graph, ended by a synchronise (s)."""


def read(ctx):
    return ctx["prepare_s"]
