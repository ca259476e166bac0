"""Forward models of the port (Darcy only in this slice)."""
