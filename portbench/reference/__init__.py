"""Plain float32 references of the configurations: no import of the program."""
