"""Models of the port: tree, grower, boosting loop."""
