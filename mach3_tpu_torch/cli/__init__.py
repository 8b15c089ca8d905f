"""Console entry points of the port (``mach3-mcmc-torch``)."""
