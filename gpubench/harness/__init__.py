"""The benchmark's general machinery: the manifest and the files it names,
the result line, the import guard and the reduction of a profiler trace."""
