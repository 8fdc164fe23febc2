"""Adapters from a configuration file to the program's model family, one
module per ``kind``."""
