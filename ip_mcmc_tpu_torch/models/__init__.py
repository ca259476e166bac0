"""Forward models of the port: Darcy, Burgers, and the linear model."""
