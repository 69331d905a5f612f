"""One driver per entry of the program that a traffic file names."""
