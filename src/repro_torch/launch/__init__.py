"""Entry points of the port: ``launch.train``, the DP training CLI."""
