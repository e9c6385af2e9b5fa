"""The harness's shared machinery: cells, runs, traces, inputs, checks."""
