"""Plan IR and the plan -> operator builder."""
