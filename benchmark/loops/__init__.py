"""Traffic loops, one a module, found by a mix's ``loop`` key."""
