"""MAC: the test-mode traffic generator and the cell scheduler."""
