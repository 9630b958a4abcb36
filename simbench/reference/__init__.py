"""The plain reference the check compares the program with. It imports
nothing of the program."""
