"""Generator construction and the synthesis (serving) function."""
