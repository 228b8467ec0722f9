from .loop import main

main()
