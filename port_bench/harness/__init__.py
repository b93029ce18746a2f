"""The benchmark's harness: finding a cell's parts, drawing its inputs,
driving the program, reading the trace and checking the outputs."""
