"""The benchmark's own library: what every cell shares (loading the cell and
its parts by name, the seeded weights, the timed loop, the trace reading,
the peaks and the comparison that decides ``correct``)."""
