"""The plain reference (``plain.py``); it imports nothing of the program."""
