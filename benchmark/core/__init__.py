"""The benchmark's yardstick: cell lookup, window arithmetic, the trace
reader, the table of peaks and the result line."""
