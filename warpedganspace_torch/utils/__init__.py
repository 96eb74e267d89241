"""Host-side helpers: ``.pt`` tensor IO and the terminal progress UI."""
