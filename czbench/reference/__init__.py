"""Plain references of the configurations, one module a solver name."""
