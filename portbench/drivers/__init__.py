"""One module for each kind of configuration (a configuration file's
``driver``): it builds the program's side of a cell, by the cell's
``mode``, as a :class:`portbench.session.Session`."""
