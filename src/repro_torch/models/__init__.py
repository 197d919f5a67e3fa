"""Taps-enabled models: the paper's CNNs (``cnn``) on the shared blocks
(``common``, ``convops``)."""
