"""Times a view the program made the host wait on the card, as its
own ``host_wait.<site>`` counters count them in the traced window, summed
over the sites."""
from port_bench.harness import program_trace


def read(ctx):
    return program_trace.counted(ctx, "serve", "host_wait.")
