"""The benchmark's own machinery: the manifest and cell files, seeds,
the chip's peaks, the reduction of a profiler trace, and the result
line.  Nothing here imports the program (`repro_torch`); the drivers
under ``perfbench/drivers`` do, and only they."""
