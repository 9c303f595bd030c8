"""The harness's own machinery: the specification it reads, the seeds, the
metric arithmetic, the peaks and bounds, the inputs and weights it makes,
the trace it reads and the result line it prints."""
