"""Traffic generators: each reads the parameters of a cell's file and
makes its inputs from the seed."""
