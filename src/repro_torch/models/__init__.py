"""Model layers of the port: deploy faces of the dense decoder."""
