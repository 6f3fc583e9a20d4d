"""One-off measurements that define the cells: the rate sweep that finds a
traffic's knee, and the readings that a check's limit is set from."""
