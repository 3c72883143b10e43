"""The plain float32 reference that the benchmark's check holds the
program to; it imports nothing of the program."""
