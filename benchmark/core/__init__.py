"""The benchmark's yardstick: the import guard, spans around the
program's calls, the trace reader, the operation and byte counts and the
peaks, seeded weights and traffic, and the result line."""
