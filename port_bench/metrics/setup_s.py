"""Seconds from the process's start to the first timed step: imports, the
card's context, the inputs drawn, the program set up and warmed up."""


def read(ctx):
    return ctx["setup_s"]
