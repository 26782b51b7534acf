"""The benchmark's plain reference of the plume frame: numpy and torch only,
in any float dtype (float64 for the check, bfloat16 for its control). It
imports nothing of the program under test and takes none of its tables: it
builds its own tile index from the tile list."""
