"""The plain PyTorch reference of the CICS day that decides ``correct``: a
frozen copy of the day's arithmetic, with no kernel, that imports nothing
of the program."""
