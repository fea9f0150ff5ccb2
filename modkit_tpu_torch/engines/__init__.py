"""Analysis engines (one per subcommand family), reference src/ L4 layer."""
