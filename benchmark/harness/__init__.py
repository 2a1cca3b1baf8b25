"""The benchmark's harness: discovery by name, the traffic generator and
timed window, the comparison with the plain reference, trace reading and
the roofline arithmetic."""
