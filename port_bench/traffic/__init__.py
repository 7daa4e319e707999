"""Traffic kinds: each makes a cell's inputs from the seed and drives its window."""
