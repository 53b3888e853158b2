"""Search engine layer of the port: the reader side of NamedIndex."""
