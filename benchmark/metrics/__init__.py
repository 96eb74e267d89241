"""One reader per per-layer metric, in a file named after the metric ('.' as
'_'). ``read(view)`` returns the metric's value from the traced run, or None
where the run holds nothing for it to read; the harness then leaves the
metric out of the result line."""
