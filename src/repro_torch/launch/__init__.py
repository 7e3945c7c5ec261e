"""Command-line launchers and the LM serving steps."""
