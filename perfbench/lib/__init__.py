"""The benchmark's harness: specification, instances, the measured window,
the device trace and the check of what the window produced."""
