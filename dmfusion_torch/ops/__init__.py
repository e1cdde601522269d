"""Device ops of the port: the window-gather and phase window-pool
kernels (each beside its plain version) and metrics."""
