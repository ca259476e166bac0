"""Forward models of the port: Darcy, Burgers, the RK4 ODEs and the linear model."""
