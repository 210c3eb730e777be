"""Needed-work counts: the operations and bytes that a layer's work needs,
from the cell's shapes alone (not from launches, nor from what one kernel
design executes), for the per-layer roofline shares."""
