"""Platform probes on the card: measurements that answer design questions
(``gather``: random row fetches and in-tile gathers), not parts of the
render."""
