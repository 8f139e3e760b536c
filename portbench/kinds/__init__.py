"""One module per kind of traffic (a traffic file's ``kind``): it sets
the cell up, runs its window and checks its output against the plain
reference."""
