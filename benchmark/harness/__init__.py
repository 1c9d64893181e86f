"""The benchmark's harness: cells, traffic loops, tracing, the comparison
with the plain reference, and the guards a run keeps."""
