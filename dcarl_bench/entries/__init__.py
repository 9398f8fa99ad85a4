"""One module for each entry point of the port that a cell drives,
named by the configuration's ``entry``; each has ``run(cell, seed,
seconds, trace, device, t_start, control)`` returning the result line."""
